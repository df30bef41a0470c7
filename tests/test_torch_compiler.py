"""The port's graph compiler (``paddle_tpu_torch.compiler``) against the
JAX package's unfused programs: every case of ``tests/test_compiler.py``.

Each pattern case writes the composition twice, in jnp (the JAX test's
own reference) and in torch (what a plain-op port model captures to),
runs the torch one through ``compiler.optimize`` (capture, pipeline,
replay of the rewritten program) and holds its output to the JAX
package's UNFUSED output on the same numpy inputs, with the rewrite
counted once. The JAX package's own fused runs are no anchor (five of
its compiler tests are red on this jax, ROADMAP §A.7). Tolerances:
float32 1e-6 absolute where the port's kernel (its plain version on the
CPU) computes the composition's own operations in another order, 2e-6
for the longer chains, bf16 0.06 as in the JAX test.

Then: negative matches (no candidate and an identity pass), the fallback
guarantee, the cleanup passes, the pass manager (order, a failing pass
skipped, dumps, timings), remat tags (also inside a descended
``torch.cond`` branch), and integration: 10 steps of
``compile_train_step(fuse=True)`` on ``fusion_audit_torch.PlainLlama``
carrying the JAX tiny Llama's weights against the JAX package's
unfused 10-step losses at rtol 1e-4, with one captured program and the
architecture's rewrite counts (per L layers: attention L, rms_norm
2L + 1, swiglu L, rope 2L); ``remat_policy="fused"`` equal to
``fuse=False``.
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as TF

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import jit as jjit
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import compiler, weights
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.compiler import (PassContext, PassManager,
                                       find_candidates, optimize)
from paddle_tpu_torch.compiler.remat import checkpoint_names
from paddle_tpu_torch.jit import compile_train_step
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.nn.functional import _sdpa_dense
from paddle_tpu_torch.observability.events import EVENTS
from paddle_tpu_torch.observability.metrics import REGISTRY as REG

RNG = np.random.default_rng(0)
PATTERNS = ("attention", "rms_norm", "swiglu", "rope")


def npf(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def counter(name, pattern=None):
    c = REG.get(name, {"pattern": pattern} if pattern else None)
    return c.value if c is not None else 0


def rewrites(pattern):
    return counter("compiler_rewrites_total", pattern)


def _audit():
    spec = importlib.util.spec_from_file_location(
        "fusion_audit_torch", os.path.join(os.path.dirname(__file__), "..",
                                           "fusion_audit_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the unfused compositions, in jnp (the JAX test's) and in torch
# ---------------------------------------------------------------------------

def j_rms(x, w, eps=1e-6):
    ms = jnp.mean(jnp.square(x), axis=-1, keepdims=True)
    return (x * jnp.reciprocal(jnp.sqrt(ms + eps))) * w


def t_rms(x, w, eps=1e-6):
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.reciprocal(torch.sqrt(ms + eps))) * w


def j_attn(q, k, v, mask=None, causal=True, scale=None):
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qt, kt, vt = (jnp.swapaxes(x, 1, 2) for x in (q, k, v))
    if kt.shape[1] != qt.shape[1]:
        rep = qt.shape[1] // kt.shape[1]
        kt, vt = jnp.repeat(kt, rep, 1), jnp.repeat(vt, rep, 1)
    logits = jnp.einsum("bhsd,bhtd->bhst", qt, kt) * scale
    if causal:
        s, tt = logits.shape[-2], logits.shape[-1]
        cm = jnp.tril(jnp.ones((s, tt), bool), k=tt - s)
        logits = jnp.where(cm, logits, jnp.asarray(-1e30, logits.dtype))
    if mask is not None:
        if mask.dtype == jnp.bool_:
            logits = jnp.where(mask, logits, jnp.asarray(-1e30,
                                                         logits.dtype))
        else:
            logits = logits + mask
    probs = jax.nn.softmax(logits, axis=-1)
    return jnp.swapaxes(jnp.einsum("bhst,bhtd->bhsd", probs, vt), 1, 2)


def t_attn(q, k, v, mask=None, causal=True, scale=None):
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if kt.shape[1] != qt.shape[1]:
        rep = qt.shape[1] // kt.shape[1]
        kt, vt = kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)
    logits = torch.einsum("bhsd,bhtd->bhst", qt, kt) * scale
    if causal:
        s, tt = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(s, tt, dtype=torch.bool).tril(tt - s)
        logits = torch.where(cm, logits, torch.tensor(-1e30))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, torch.tensor(-1e30))
        else:
            logits = logits + mask
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, vt).transpose(1, 2)


def j_rope(x, cos, sin):
    cb = jnp.broadcast_to(cos[None, :, None, :], x.shape).astype(x.dtype)
    sb = jnp.broadcast_to(sin[None, :, None, :], x.shape).astype(x.dtype)
    d = x.shape[-1]
    rot = jnp.concatenate([-x[..., d // 2:], x[..., :d // 2]], axis=-1)
    return x * cb + rot * sb


def t_rope(x, cos, sin):
    d = x.shape[-1]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return (x * cos[None, :, None, :].to(x.dtype)
            + rot * sin[None, :, None, :].to(x.dtype))


def run_fused(fn, *args, name="t", pass_manager=None):
    """(optimized output, rewrite counter deltas by pattern)."""
    before = {p: rewrites(p) for p in PATTERNS}
    out = optimize(fn, name=name, pass_manager=pass_manager)(*args)
    return out, {p: rewrites(p) - before[p] for p in PATTERNS}


def ptt_nodes(gm):
    return [n.target.name() for n in gm.graph.nodes
            if isinstance(n.target, torch._ops.OpOverload)
            and n.target.namespace == "ptt"]


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# per-pattern parity against the JAX package's unfused output
# ---------------------------------------------------------------------------

class TestPatternParity:
    def test_rms_norm_f32(self):
        x, w = npf(4, 64), npf(64)
        out, d = run_fused(t_rms, t(x), t(w), name="rms")
        assert d["rms_norm"] == 1
        _close(out, j_rms(x, w), 1e-6)

    def test_rms_norm_bf16_cast_chain(self):
        def j_bf16(x, w):
            xf = x.astype(jnp.float32)
            ms = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
            return (xf * jnp.reciprocal(jnp.sqrt(ms + 1e-6))
                    ).astype(x.dtype) * w

        def t_bf16(x, w):
            xf = x.float()
            ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
            return (xf * torch.reciprocal(torch.sqrt(ms + 1e-6))
                    ).to(x.dtype) * w
        x, w = npf(4, 64), npf(64)
        tx, tw = t(x).bfloat16(), t(w).bfloat16()
        out, d = run_fused(t_bf16, tx, tw, name="rms_bf16")
        assert d["rms_norm"] == 1
        assert out.dtype == torch.bfloat16
        want = j_bf16(jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(w, jnp.bfloat16))
        _close(out, want, 0.06)

    def test_rms_norm_rsqrt_and_bias_variant(self):
        def j2(x, w, b):
            ms = jnp.mean(x * x, axis=-1, keepdims=True)
            return x * jax.lax.rsqrt(ms + 1e-5) * w + b

        def t2(x, w, b):
            ms = torch.mean(x * x, dim=-1, keepdim=True)
            return x * torch.rsqrt(ms + 1e-5) * w + b
        x, w, b = npf(4, 32), npf(32), npf(32)
        out, d = run_fused(t2, t(x), t(w), t(b), name="rms_rsqrt")
        assert d["rms_norm"] == 1
        _close(out, j2(x, w, b), 2e-6)

    def test_swiglu(self):
        a, b = npf(4, 64), npf(4, 64)
        out, d = run_fused(lambda a, b: TF.silu(a) * b, t(a), t(b),
                           name="swiglu")
        assert d["swiglu"] == 1
        _close(out, jax.nn.silu(a) * b, 1e-6)

    def test_swiglu_inline_sigmoid_form(self):
        a, b = npf(4, 32), npf(4, 32)
        out, d = run_fused(lambda a, b: (a * torch.sigmoid(a)) * b, t(a),
                           t(b), name="swiglu_inline")
        assert d["swiglu"] == 1
        _close(out, (a * jax.nn.sigmoid(a)) * b, 1e-6)

    def test_rope_parity(self):
        x, cos, sin = npf(2, 8, 4, 16), npf(8, 16), npf(8, 16)
        out, d = run_fused(t_rope, t(x), t(cos), t(sin), name="rope")
        assert d["rope"] == 1
        _close(out, j_rope(x, cos, sin), 2e-6)

    def test_rope_bhsd_layout(self):
        """The same rotation on [B, H, S, D] (tables on axes 2 and 3)."""
        def t_bhsd(x, cos, sin):
            d = x.shape[-1]
            rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
            return x * cos[None, None] + rot * sin[None, None]
        x, cos, sin = npf(2, 4, 8, 16), npf(8, 16), npf(8, 16)
        out, d = run_fused(t_bhsd, t(x), t(cos), t(sin), name="rope_bhsd")
        assert d["rope"] == 1
        want = np.swapaxes(np.asarray(j_rope(np.swapaxes(x, 1, 2), cos,
                                             sin)), 1, 2)
        _close(out, want, 2e-6)

    def test_attention_causal(self):
        q, k, v = npf(2, 8, 4, 16), npf(2, 8, 4, 16), npf(2, 8, 4, 16)
        out, d = run_fused(lambda q, k, v: t_attn(q, k, v), t(q), t(k),
                           t(v), name="attn_causal")
        assert d["attention"] == 1
        _close(out, j_attn(q, k, v), 1e-6)

    def test_attention_gqa_via_port_sdpa_dense(self):
        """The port's own plain attention (``_sdpa_dense``, GQA by
        repeat_interleave) is an unfused composition too."""
        q, k, v = npf(2, 8, 4, 16), npf(2, 8, 2, 16), npf(2, 8, 2, 16)

        def fn(q, k, v):
            return _sdpa_dense(q, k, v, None, 0.0, True, training=False)
        gm, _ = compiler.capture(fn, [t(q), t(k), t(v)])
        cands, _ = find_candidates(gm, ["attention"])
        assert len(cands) == 1
        assert cands[0].params["h"] == 4 and cands[0].params["h_kv"] == 2
        out, d = run_fused(fn, t(q), t(k), t(v), name="attn_gqa")
        assert d["attention"] == 1
        _close(out, j_attn(q, k, v), 1e-6)

    def test_attention_matmul_form(self):
        """``@`` in place of einsum, the mask by masked_fill, the softmax
        in float32: the same candidate."""
        def fn(q, k, v):
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            logits = (qt @ kt.transpose(-1, -2)) / 4.0
            s, tt = logits.shape[-2:]
            cm = torch.ones(s, tt, dtype=torch.bool).tril(tt - s)
            logits = logits.masked_fill(~cm, float("-inf"))
            p = torch.softmax(logits.float(), -1).to(q.dtype)
            return (p @ vt).transpose(1, 2)
        q, k, v = npf(2, 8, 4, 16), npf(2, 8, 4, 16), npf(2, 8, 4, 16)
        out, d = run_fused(fn, t(q), t(k), t(v), name="attn_matmul")
        assert d["attention"] == 1
        _close(out, j_attn(q, k, v, scale=0.25), 1e-6)

    def test_attention_bool_mask_var(self):
        q, k, v = npf(2, 6, 4, 8), npf(2, 6, 4, 8), npf(2, 6, 4, 8)
        mask = RNG.integers(0, 2, (6, 6)).astype(bool)
        fn = lambda q, k, v, m: t_attn(q, k, v, mask=m,  # noqa: E731
                                       causal=False)
        out, d = run_fused(fn, t(q), t(k), t(v), t(mask), name="attn_mask")
        assert d["attention"] == 1
        _close(out, j_attn(q, k, v, mask=jnp.asarray(mask), causal=False),
               1e-6)

    def test_attention_additive_mask(self):
        q, k, v = npf(2, 6, 4, 8), npf(2, 6, 4, 8), npf(2, 6, 4, 8)
        mask = npf(2, 1, 6, 6) * 3.0
        fn = lambda q, k, v, m: t_attn(q, k, v, mask=m,  # noqa: E731
                                       causal=False)
        out, d = run_fused(fn, t(q), t(k), t(v), t(mask), name="attn_add")
        assert d["attention"] == 1
        _close(out, j_attn(q, k, v, mask=mask, causal=False), 1e-6)

    def test_attention_explicit_scale(self):
        q, k, v = npf(1, 5, 2, 8), npf(1, 5, 2, 8), npf(1, 5, 2, 8)
        fn = lambda q, k, v: t_attn(q, k, v, causal=True,  # noqa: E731
                                    scale=0.5)
        out, d = run_fused(fn, t(q), t(k), t(v), name="attn_scale")
        assert d["attention"] == 1
        _close(out, j_attn(q, k, v, causal=True, scale=0.5), 1e-6)

    def test_sdpa_is_left_alone(self):
        """F.scaled_dot_product_attention is one op already."""
        q = t(npf(2, 4, 8, 16))
        gm, _ = compiler.capture(
            lambda q: TF.scaled_dot_product_attention(q, q, q,
                                                      is_causal=True), [q])
        assert find_candidates(gm)[0] == []

    def test_grads_flow_through_fused_ops(self):
        x, w = npf(4, 32), npf(32)
        g_ref = jax.grad(lambda x, w: j_rms(x, w).sum(),
                         argnums=(0, 1))(x, w)
        tx, tw = t(x).requires_grad_(), t(w).requires_grad_()
        fused = optimize(lambda x, w: t_rms(x, w).sum(), name="rms_grad")
        fused(tx, tw).backward()
        prog = fused.programs.values()[0]
        assert "ptt::rms_norm" in ptt_nodes(prog)
        _close(tx.grad, g_ref[0], 2e-6)
        _close(tw.grad, g_ref[1], 2e-6)


# ---------------------------------------------------------------------------
# matcher edge cases: no rewrite on a structural or shape mismatch
# ---------------------------------------------------------------------------

class TestNegativeMatches:
    def assert_no_candidates(self, fn, *args, patterns=None):
        gm, _ = compiler.capture(fn, [t(a) for a in args])
        cands, _ = find_candidates(gm, list(patterns or PATTERNS))
        assert cands == []
        # and the pass is an identity (the same object back)
        assert compiler.PatternFusionPass().run(gm, PassContext("neg")) is gm

    def test_rms_wrong_divisor_no_rewrite(self):
        def bad(x, w):   # mean over the wrong count: NOT an rms_norm
            ms = torch.sum(torch.square(x), dim=-1, keepdim=True) / 999.0
            return (x * torch.reciprocal(torch.sqrt(ms + 1e-6))) * w
        self.assert_no_candidates(bad, npf(4, 32), npf(32))

    def test_rms_different_tensor_no_rewrite(self):
        def bad(x, y, w):  # normalizes x by ||y||
            ms = torch.mean(torch.square(y), dim=-1, keepdim=True)
            return (x * torch.reciprocal(torch.sqrt(ms + 1e-6))) * w
        self.assert_no_candidates(bad, npf(4, 32), npf(4, 32), npf(32))

    def test_rms_without_weight_no_rewrite(self):
        def bare(x):     # the fused op's contract needs the weight
            ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
            return x * torch.reciprocal(torch.sqrt(ms + 1e-6))
        self.assert_no_candidates(bare, npf(4, 32))

    def test_glu_is_not_swiglu(self):
        self.assert_no_candidates(lambda a, b: a * torch.sigmoid(b),
                                  npf(4, 32), npf(4, 32))

    def test_softmax_wrong_axis_no_rewrite(self):
        def bad(q, k, v):
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            logits = torch.einsum("bhsd,bhtd->bhst", qt, kt) * 0.25
            probs = torch.softmax(logits, dim=-2)      # wrong axis
            return torch.einsum("bhst,bhtd->bhsd", probs, vt)
        self.assert_no_candidates(bad, npf(1, 4, 2, 8), npf(1, 4, 2, 8),
                                  npf(1, 4, 2, 8))

    def test_rope_unrecoverable_tables_no_rewrite(self):
        def bad(x, cos4, sin4):   # tables already rank-4 and computed
            d = x.shape[-1]
            rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
            return x * (cos4 + 1.0) + rot * (sin4 + 1.0)
        self.assert_no_candidates(bad, npf(2, 8, 4, 16), npf(2, 8, 4, 16),
                                  npf(2, 8, 4, 16), patterns=["rope"])

    def test_additive_mask_under_scale_no_rewrite(self):
        """softmax((QK + bias) * s) must NOT rewrite: the fused form would
        compute s*QK + bias, silently unscaling the bias."""
        def bad(q, k, v, bias):
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            logits = (torch.einsum("bhsd,bhtd->bhst", qt, kt) + bias) * 0.5
            probs = torch.softmax(logits, dim=-1)
            return torch.einsum("bhst,bhtd->bhsd", probs, vt)
        self.assert_no_candidates(bad, npf(1, 4, 2, 8), npf(1, 4, 2, 8),
                                  npf(1, 4, 2, 8), npf(1, 2, 4, 4),
                                  patterns=["attention"])

    def test_int_keep_mask_coerced_to_bool(self):
        """An int 0/1 keep mask must mask, never ADD through the dense
        path's additive branch: the model's own coercion (torch.where
        takes a bool condition) matches, and the fused target coerces an
        int mask it is handed."""
        def fn(q, k, v, m):
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            logits = torch.einsum("bhsd,bhtd->bhst", qt, kt) * 0.25
            logits = torch.where(m != 0, logits, torch.tensor(-1e30))
            probs = torch.softmax(logits, dim=-1)
            return torch.einsum("bhst,bhtd->bhsd", probs, vt)

        def jfn(q, k, v, m):
            qt, kt, vt = (jnp.swapaxes(x, 1, 2) for x in (q, k, v))
            logits = jnp.einsum("bhsd,bhtd->bhst", qt, kt) * 0.25
            logits = jnp.where(m, logits, jnp.asarray(-1e30, logits.dtype))
            return jnp.einsum("bhst,bhtd->bhsd",
                              jax.nn.softmax(logits, axis=-1), vt)
        q, k, v = npf(1, 6, 2, 8), npf(1, 6, 2, 8), npf(1, 6, 2, 8)
        m = RNG.integers(0, 2, (6, 6)).astype(np.int32)
        out, d = run_fused(fn, t(q), t(k), t(v), t(m), name="attn_intmask")
        assert d["attention"] == 1
        _close(out, jfn(q, k, v, m), 1e-6)
        tq, tk, tv = (t(x) for x in (q, k, v))
        got = compiler.rewrites.fused_attention(tq, tk, tv, t(m)[None, None],
                                                scale=0.25, mask_mode="keep")
        _close(got.transpose(1, 2), jfn(q, k, v, m), 1e-6)

    def test_fallback_guarantee_on_bad_builder(self):
        """A rewrite whose replacement disagrees with the head's value is
        refused; the program still runs and a fallback is recorded."""
        def matcher(g):
            return [compiler.Candidate("bad_sin", n, [n.args[0]])
                    for n in g.graph.nodes
                    if n.target is torch.ops.aten.sin.default]

        def builder(cand):
            return lambda x: torch.zeros(3, 3)     # wrong shape
        bad_pass = compiler.make_fused_pass("bad_sin", matcher, builder)
        pm = PassManager([bad_pass, "dce"])
        x = npf(4, 4)
        before = counter("compiler_fallbacks_total", "bad_sin")
        out = optimize(torch.sin, name="fallback", pass_manager=pm)(t(x))
        _close(out, np.sin(x), 1e-6)
        assert counter("compiler_fallbacks_total", "bad_sin") == before + 1
        assert len(EVENTS.events("compiler_fallback")) >= 1

    def test_capture_refuses_an_autograd_function(self):
        """A capture never inlines an autograd Function's forward: the
        mpu layers' collectives break the graph, and the call runs
        eagerly with its own backward."""
        class Twice(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * 2.0

            @staticmethod
            def backward(ctx, g):
                return g * 3.0      # not the forward's derivative

        def fn(x):
            return Twice.apply(x)
        with pytest.raises(compiler.GraphBreak, match="autograd.Function"):
            compiler.capture(fn, [t(npf(3))])
        before = counter("compiler_graph_breaks_total")
        x = t(npf(3)).requires_grad_()
        optimize(fn, name="twice")(x).sum().backward()
        assert counter("compiler_graph_breaks_total") == before + 1
        assert torch.equal(x.grad, torch.full((3,), 3.0))


# ---------------------------------------------------------------------------
# cleanup passes
# ---------------------------------------------------------------------------

def _ops_of(gm, target):
    return sum(1 for n in gm.graph.nodes if n.target is target)


class TestCleanup:
    def test_dce_removes_dead_keeps_live(self):
        def fn(x):
            dead = torch.tanh(x) * 3.0      # never used
            del dead
            return x * 2.0
        gm, _ = compiler.capture(fn, [t(npf(4))])
        assert _ops_of(gm, torch.ops.aten.tanh.default) == 1
        out = compiler.cleanup.dce(gm)
        assert _ops_of(out, torch.ops.aten.tanh.default) == 0
        assert compiler.pass_manager.n_nodes(out) == 1
        # signature kept
        assert [n.name for n in out.graph.nodes if n.op == "placeholder"] \
            == [n.name for n in gm.graph.nodes if n.op == "placeholder"]

    def test_dce_identity_when_all_live(self):
        gm, _ = compiler.capture(lambda x: x * 2.0, [t(npf(4))])
        assert compiler.cleanup.dce(gm) is gm

    def test_cse_merges_duplicates(self):
        gm, _ = compiler.capture(lambda x: torch.tanh(x) + torch.tanh(x),
                                 [t(npf(8))])
        assert _ops_of(gm, torch.ops.aten.tanh.default) == 2
        out = compiler.cleanup.CSEPass().run(gm, PassContext())
        assert _ops_of(out, torch.ops.aten.tanh.default) == 1
        x = torch.ones(8)
        _close(out(x)[0], np.asarray(torch.tanh(x) * 2), 1e-6)

    def test_constant_fold_bakes_const_chain(self):
        def fn(x):
            c = torch.arange(8, dtype=torch.float32) * 2.0 + 1.0
            return x + c
        gm, _ = compiler.capture(fn, [t(npf(8))])
        out = compiler.cleanup.ConstantFoldPass().run(gm, PassContext())
        assert out is not gm
        assert compiler.pass_manager.n_nodes(out) < \
            compiler.pass_manager.n_nodes(gm)
        _close(out(torch.zeros(8))[0], np.arange(8) * 2.0 + 1.0, 1e-6)

    def test_cse_and_fold_leave_in_place_writes_alone(self):
        """A constant written in place stays computed per call, and two
        equal constants stay two: a merged or stored one would carry one
        call's writes into the next."""
        def fn(x):
            a = torch.zeros(4)
            b = torch.zeros(4)
            a.add_(x)
            return a + b
        gm, _ = compiler.capture(fn, [t(npf(4))])
        for p in (compiler.cleanup.CSEPass(),
                  compiler.cleanup.ConstantFoldPass()):
            assert p.run(gm, PassContext()) is gm
        fused = optimize(fn, name="inplace")
        x = t(npf(4))
        for _ in range(2):
            _close(fused(x), x.numpy(), 0)

    def test_constant_fold_identity_without_consts(self):
        gm, _ = compiler.capture(lambda x, y: x * y, [t(npf(4)), t(npf(4))])
        assert compiler.cleanup.ConstantFoldPass().run(
            gm, PassContext()) is gm


# ---------------------------------------------------------------------------
# pass manager
# ---------------------------------------------------------------------------

def _has_cond():
    return hasattr(torch, "cond")


class TestPassManager:
    def test_ordering_and_surgery(self):
        pm = PassManager()
        assert pm.names() == ["pattern_fusion", "remat_tag",
                              "constant_fold", "cse", "dce"]
        pm.remove("cse")
        assert "cse" not in pm.names()
        pm.add("cse", after="constant_fold")
        assert pm.names().index("cse") == \
            pm.names().index("constant_fold") + 1
        with pytest.raises(KeyError):
            pm.add("nonexistent_pass")

    def test_failing_pass_is_skipped(self):
        class Boom(compiler.Pass):
            name = "boom"

            def run(self, gm, ctx):
                raise RuntimeError("kaput")
        pm = PassManager([Boom(), "dce"])
        x = npf(4)
        before = counter("compiler_pass_errors_total")
        out = optimize(lambda x: x * 2.0, name="boom", pass_manager=pm)(t(x))
        _close(out, x * 2.0, 0)
        assert counter("compiler_pass_errors_total") == before + 1
        assert EVENTS.events("compiler_pass_error")[-1]["pass_name"] == "boom"

    def test_dump_writes_before_after(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PADDLE_TPU_COMPILER_DUMP", str(tmp_path))
        optimize(t_rms, name="dump_prog")(t(npf(4, 32)), t(npf(32)))
        files = sorted(p.name for p in tmp_path.iterdir())
        assert any("pattern_fusion.before" in f for f in files)
        assert any("pattern_fusion.after" in f for f in files)
        assert any(f.endswith("final.txt") for f in files)
        after = next(p for p in tmp_path.iterdir()
                     if "pattern_fusion.after" in p.name)
        assert "ptt.rms_norm" in after.read_text()
        final = next(p for p in tmp_path.iterdir()
                     if p.name.endswith("final.txt"))
        assert "fused_rms_norm" in final.read_text()   # its remat tag

    def test_pass_timings_recorded(self):
        optimize(t_rms, name="timing")(t(npf(4, 32)), t(npf(32)))
        h = REG.get("compiler_pass_seconds", {"pass": "pattern_fusion"})
        assert h is not None and h.count > 0
        ev = EVENTS.events("compiler_program")[-1]
        assert ev["program"] == "timing" and ev["rewrites"] == 1
        assert ev["eqns_after"] < ev["eqns_before"]

    def test_remat_tag_inserts_names(self):
        fused = optimize(t_rms, name="tags")
        fused(t(npf(4, 32)), t(npf(32)))
        prog = fused.programs.values()[0]
        assert checkpoint_names(prog) == ["fused_rms_norm"]
        assert ptt_nodes(prog) == ["ptt::rms_norm"]

    @pytest.mark.skipif(not _has_cond(), reason="torch.cond is missing")
    def test_remat_tag_reaches_descended_subgraphs(self):
        """Fused ops spliced INSIDE a torch.cond branch get their tags
        there too, and the program still computes the composition."""
        def fn(x, w):
            return torch.cond(x.sum() > 0, lambda x, w: t_rms(x, w),
                              lambda x, w: x * 2.0, (x, w))
        fused = optimize(fn, name="cond_tags")
        x, w = npf(4, 32), npf(32)
        x = np.abs(x)                     # the rms branch
        out = fused(t(x), t(w))
        prog = fused.programs.values()[0]
        assert checkpoint_names(prog) == ["fused_rms_norm"]
        _close(out, j_rms(x, w), 2e-6)
        _close(fused(t(-x), t(w)), -x * 2.0, 0)


# ---------------------------------------------------------------------------
# integration: compile_train_step / remat / descent
# ---------------------------------------------------------------------------

def _jax_tiny(seed=0):
    paddle.seed(seed)
    cfg = JaxLlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4,
                              kv_heads=2, ffn=64, seq=64)
    return JaxLlama(cfg), cfg


def _plain_from_jax(jm):
    fa = _audit()
    cfg = LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4,
                           kv_heads=2, ffn=64, seq=64)
    return weights.from_paddle_tpu_state(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()},
        fa.PlainLlama(cfg))


class TestIntegration:
    def test_train_step_10_steps_parity_counters_no_recaptures(self):
        """10 steps of compile_train_step(fuse=True) on the plain-op tiny
        Llama with the JAX tiny Llama's weights: the JAX package's
        unfused losses at rtol 1e-4, one captured program for the 10
        steps, and the architecture's rewrites (2 layers)."""
        jm, cfg = _jax_tiny(0)
        tm = _plain_from_jax(jm)
        rng = np.random.default_rng(7)
        ids = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        lab = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        jstep = jjit.compile_train_step(
            jm, lambda m, i, l: m(i, labels=l),
            jopt.AdamW(1e-3, parameters=jm.parameters()), fuse=False)
        want = [float(jstep(paddle.to_tensor(ids),
                            paddle.to_tensor(lab)).numpy())
                for _ in range(10)]
        tm.train()
        step = compile_train_step(
            tm, lambda m, i, l: m(i, labels=l),
            topt.AdamW(1e-3, parameters=tm.parameters()), fuse=True)
        before = {p: rewrites(p) for p in PATTERNS}
        progs = counter("compiler_programs_total")
        got = [float(step(t(ids).long(), t(lab).long())) for _ in range(10)]
        assert counter("compiler_programs_total") == progs + 1
        assert len(step.programs) == 1
        assert {p: rewrites(p) - before[p] for p in PATTERNS} == \
            {"attention": 2, "rms_norm": 5, "swiglu": 2, "rope": 4}
        np.testing.assert_allclose(got, want, rtol=1e-4)

    def test_remat_policy_fused_equals_unfused(self):
        jm, cfg = _jax_tiny(3)
        rng = np.random.default_rng(9)
        ids = t(rng.integers(0, cfg.vocab_size, (2, 16)))
        lab = t(rng.integers(0, cfg.vocab_size, (2, 16)))
        losses = {}
        for kw in ({"fuse": False},
                   {"fuse": True, "remat_policy": "fused"}):
            tm = _plain_from_jax(jm)
            tm.train()
            step = compile_train_step(
                tm, lambda m, i, l: m(i, labels=l),
                topt.AdamW(1e-3, parameters=tm.parameters()), **kw)
            losses[kw["fuse"]] = [float(step(ids, lab)) for _ in range(3)]
        np.testing.assert_allclose(losses[True], losses[False], rtol=1e-4)

    def test_fused_remat_recomputes_all_but_the_fused_ops(self):
        """Under the fused policy the backward reruns the matmuls but no
        fused op: each kernel's op runs once a step; the program is cut
        into pieces checkpointed apart (a backward recomputes piece by
        piece)."""
        from torch.utils._python_dispatch import TorchDispatchMode

        class Calls(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.n = {}

            def __torch_dispatch__(self, func, types, args=(), kw=None):
                key = func.name()
                self.n[key] = self.n.get(key, 0) + 1
                return func(*args, **(kw or {}))
        jm, cfg = _jax_tiny(4)
        rng = np.random.default_rng(11)
        ids = t(rng.integers(0, cfg.vocab_size, (2, 16)))
        counts, progs = {}, []
        for kw in ({"fuse": True}, {"fuse": True, "remat_policy": "fused"}):
            tm = _plain_from_jax(jm)
            tm.train()
            step = compile_train_step(
                tm, lambda m, i, l: m(i, labels=l),
                topt.AdamW(1e-3, parameters=tm.parameters()), **kw)
            step(ids, ids)                   # the capture
            with Calls() as c:
                step(ids, ids)
            counts[len(kw)] = c.n
            progs.append(step.programs.values()[0])
        plain, remat = counts[1], counts[2]
        for op in ("ptt::flash_attention_fwd", "ptt::rms_norm",
                   "ptt::swiglu", "ptt::fused_rope",
                   "ptt::flash_attention_bwd"):
            assert remat[op] == plain[op], op
        assert remat["aten::mm"] > plain["aten::mm"]
        # the remat program is cut after each of its 13 fused ops, each
        # piece checkpointed apart
        kept = sum(n for k, n in counts[1].items()
                   if k in ("ptt::flash_attention_fwd", "ptt::rms_norm",
                            "ptt::swiglu", "ptt::fused_rope"))
        assert kept == 13
        pieces = [m for m in progs[1].children()
                  if type(m).__name__ == "_Checkpointed"]
        assert len(pieces) == kept + 1
        assert not any(type(m).__name__ == "_Checkpointed"
                       for m in progs[0].children())

    def test_optimize_descends_into_cond_branches(self):
        def fn(x, w):
            return torch.cond(x.sum() > 0, lambda x, w: t_rms(x, w),
                              lambda x, w: t_rms(x * 2.0, w), (x, w))
        x, w = np.abs(npf(4, 32)), npf(32)
        out, d = run_fused(fn, t(x), t(w), name="descent_cond")
        assert d["rms_norm"] == 2
        _close(out, j_rms(x, w), 2e-6)

    def test_flag_turns_fusion_on_and_recaptures(self):
        """FLAGS_jaxpr_fusion (the JAX name) is compile_train_step's
        default; set_flags bumps the epoch, so a program captured before
        the flip is captured again."""
        from paddle_tpu_torch.framework import flags
        assert not flags.get_flag("jaxpr_fusion")
        epoch = flags.FLAGS_EPOCH[0]
        fused = optimize(t_rms, name="epoch")
        x, w = t(npf(4, 32)), t(npf(32))
        fused(x, w)
        flags.set_flags({"FLAGS_jaxpr_fusion": True})
        try:
            assert compiler.fusion_enabled()
            fused(x, w)
        finally:
            flags.set_flags({"FLAGS_jaxpr_fusion": False})
        assert flags.FLAGS_EPOCH[0] == epoch + 2
        assert len(fused.programs) == 2
