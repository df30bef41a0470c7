#!/usr/bin/env python
"""Fusion coverage audit of the PyTorch port: capture each model's forward
on the CPU, run the graph compiler, and report any fusable attention,
norm, FFN or RoPE pattern that did NOT reach a kernel. The counterpart of
``tools/fusion_audit.py`` (which stays the JAX package's).

Models: the port's Llama and GPT (``paddle_tpu_torch.models``), which
call their kernels directly, so their captures hold the kernels as
``torch.ops.ptt`` nodes already and the compiler finds nothing to do;
and ``PlainLlama``, a Llama written from plain torch ops (the
compositions of ``tests/test_compiler.py``), on which every site is a
rewrite. Each model prints one line per pattern

    model=plain_llama pattern=attention found=2 applied=2 missed=0 kernel_nodes=0 expected=2 [ok]

and the audit FAILS (exit 1) when a found candidate was not applied
(``missed > 0``) or when applied plus the kernel nodes already in the
capture fall below the architecture's floor (per L layers: attention L,
rms_norm 2L + 1, swiglu L, rope 2L; GPT attention L). Fallback reasons
are echoed under the table.

Usage:
    python fusion_audit_torch.py [--models llama,gpt,plain_llama] [--json]
"""

from __future__ import annotations

import json
import math
import os
import sys
from collections import Counter

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

LAYERS = 2


def floors(arch, layers):
    """What a model's architecture guarantees its program holds."""
    if arch == "gpt":
        return {"attention": layers}
    return {"attention": layers, "rms_norm": 2 * layers + 1,
            "swiglu": layers, "rope": 2 * layers}


# ---------------------------------------------------------------------------
# a Llama from plain torch ops, under the port Llama's parameter names
# ---------------------------------------------------------------------------

class _Weight(torch.nn.Module):
    def __init__(self, *shape, device=None, dtype=None):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.empty(*shape, device=device,
                                                     dtype=dtype))


class _Norm(_Weight):
    NORM_SCALES = ("weight",)      # weights.init_random_: ones


class _Attention(torch.nn.Module):
    def __init__(self, cfg, kw):
        super().__init__()
        h, hd = cfg.hidden_size, cfg.hidden_size // cfg.num_attention_heads
        kv = cfg.num_key_value_heads * hd
        self.q_proj, self.o_proj = _Weight(h, h, **kw), _Weight(h, h, **kw)
        self.k_proj, self.v_proj = _Weight(h, kv, **kw), _Weight(h, kv, **kw)


class _MLP(torch.nn.Module):
    def __init__(self, cfg, kw):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj, self.up_proj = _Weight(h, f, **kw), _Weight(h, f, **kw)
        self.down_proj = _Weight(f, h, **kw)


class _Layer(torch.nn.Module):
    def __init__(self, cfg, kw):
        super().__init__()
        self.self_attn = _Attention(cfg, kw)
        self.mlp = _MLP(cfg, kw)
        self.input_layernorm = _Norm(cfg.hidden_size, **kw)
        self.post_attention_layernorm = _Norm(cfg.hidden_size, **kw)


class _Model(torch.nn.Module):
    def __init__(self, cfg, kw):
        super().__init__()
        from paddle_tpu_torch.models.llama import _rope_tables
        self.embed_tokens = _Weight(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = torch.nn.ModuleList(_Layer(cfg, kw) for _ in
                                          range(cfg.num_hidden_layers))
        self.norm = _Norm(cfg.hidden_size, **kw)
        cos, sin = _rope_tables(cfg.hidden_size // cfg.num_attention_heads,
                                cfg.max_position_embeddings, cfg.rope_theta)
        self.register_buffer("rope_cos", cos.to(kw["device"]),
                             persistent=False)
        self.register_buffer("rope_sin", sin.to(kw["device"]),
                             persistent=False)


def rms_norm(x, w, eps):
    """x * reciprocal(sqrt(mean(x^2) + eps)) in float32, cast back, times w
    (``tests/test_compiler.py``'s rms_bf16 form)."""
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.reciprocal(torch.sqrt(ms + eps))).to(x.dtype) * w


def rope(x, cos, sin):
    """Rotate-half RoPE of x [B, S, H, D] from [S, D] tables cast to x's
    type."""
    d = x.shape[-1]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return (x * cos[None, :, None, :].to(x.dtype)
            + rot * sin[None, :, None, :].to(x.dtype))


def attention(q, k, v):
    """softmax(QK^T * scale) @ V under a tril mask, logits and softmax in
    float32; q [B, S, H, D], k/v [B, S, H_kv, D] (the K/V heads repeated
    for GQA)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if kt.shape[1] != qt.shape[1]:
        rep = qt.shape[1] // kt.shape[1]
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", qt, kt).float() * scale
    s, t = logits.shape[-2], logits.shape[-1]
    causal = torch.ones(s, t, dtype=torch.bool,
                        device=q.device).tril(t - s)
    logits = torch.where(causal, logits,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bhtd->bhsd", probs, vt).transpose(1, 2)


class PlainLlama(torch.nn.Module):
    """The port Llama's architecture (and parameter names: its weights load
    with ``load_state_dict`` or ``weights.from_paddle_tpu_state``) written
    from plain torch ops, none of which is a kernel: x @ W products,
    the norm, RoPE, attention and SwiGLU as compositions, and the loss as
    ``F.cross_entropy`` over the [B * S, V] logits in float32. The graph
    compiler (``compile_train_step(fuse=True)``, ``to_static``) puts the
    kernels on its path."""

    def __init__(self, cfg, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.config = cfg
        self.llama = _Model(cfg, kw)
        self.lm_head = None if cfg.tie_word_embeddings else _Weight(
            cfg.hidden_size, cfg.vocab_size, **kw)

    def hidden(self, ids):
        cfg = self.config
        b, s = ids.shape
        heads, kv = cfg.num_attention_heads, cfg.num_key_value_heads
        hd = cfg.hidden_size // heads
        m = self.llama
        x = m.embed_tokens.weight[ids]
        cos, sin = m.rope_cos[:s], m.rope_sin[:s]
        eps = cfg.rms_norm_eps
        for layer in m.layers:
            a = layer.self_attn
            h = rms_norm(x, layer.input_layernorm.weight, eps)
            q = (h @ a.q_proj.weight).view(b, s, heads, hd)
            k = (h @ a.k_proj.weight).view(b, s, kv, hd)
            v = (h @ a.v_proj.weight).view(b, s, kv, hd)
            o = attention(rope(q, cos, sin), rope(k, cos, sin), v)
            x = x + o.reshape(b, s, heads * hd) @ a.o_proj.weight
            h = rms_norm(x, layer.post_attention_layernorm.weight, eps)
            f = layer.mlp
            g = torch.nn.functional.silu(h @ f.gate_proj.weight) * \
                (h @ f.up_proj.weight)
            x = x + g @ f.down_proj.weight
        return rms_norm(x, m.norm.weight, eps)

    def forward(self, ids, labels=None):
        h = self.hidden(ids)
        w = self.llama.embed_tokens.weight.t() if self.lm_head is None \
            else self.lm_head.weight
        logits = h @ w
        if labels is None:
            return logits
        v = logits.shape[-1]
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, v).float(), labels.reshape(-1))


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------

def _llama_cfg():
    from paddle_tpu_torch.models import LlamaConfig
    return LlamaConfig.tiny(vocab=64, hidden=32, layers=LAYERS, heads=4,
                            kv_heads=2, ffn=64, seq=32)


def _build_llama():
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import LlamaForCausalLM
    return weights.init_random_(LlamaForCausalLM(_llama_cfg(),
                                                 device="cpu"), 0)


def _build_gpt():
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig.tiny(vocab=64, hidden=32, layers=LAYERS, heads=4,
                         ffn=64, seq=32)
    return weights.init_random_(GPTForCausalLM(cfg, device="cpu"), 0)


def _build_plain_llama():
    from paddle_tpu_torch import weights
    return weights.init_random_(PlainLlama(_llama_cfg()), 0)


# name -> (builder, architecture)
MODELS = {"llama": (_build_llama, "llama"), "gpt": (_build_gpt, "gpt"),
          "plain_llama": (_build_plain_llama, "llama")}

# kernel ops already in a capture -> (pattern, sites each covers)
KERNEL_NODES = {"flash_attention_fwd": ("attention", 1),
                "flashmask_attention_fwd": ("attention", 1),
                "rms_norm": ("rms_norm", 1), "swiglu": ("swiglu", 1),
                "fused_rope": ("rope", 1), "fused_rope_qk": ("rope", 2)}


def kernel_nodes(gm):
    """{pattern: sites} of the kernels' ops in a captured graph."""
    out = Counter()
    for n in gm.graph.nodes:
        t = n.target
        if isinstance(t, torch._ops.OpOverload) and t.namespace == "ptt":
            hit = KERNEL_NODES.get(t.name().split("::")[1])
            if hit is not None:
                out[hit[0]] += hit[1]
    return out


def capture_model(model, ids):
    """The eval-mode forward of `model` on ids as one captured graph, its
    parameters and buffers as inputs."""
    from paddle_tpu_torch import compiler
    model.eval()
    state = dict(model.named_parameters())
    state.update(model.named_buffers())
    names = list(state)

    def fwd(*tensors):
        return torch.func.functional_call(
            model, dict(zip(names, tensors[:len(names)])), (tensors[-1],))

    gm, _ = compiler.capture(fwd, list(state.values()) + [ids])
    return gm


def audit_model(name):
    from paddle_tpu_torch import compiler
    from paddle_tpu_torch.compiler.rewrites import DEFAULT_PATTERNS
    build, arch = MODELS[name]
    model = build()
    torch.manual_seed(0)
    ids = torch.randint(0, model.config.vocab_size, (2, 16))
    gm = capture_model(model, ids)
    kernels = kernel_nodes(gm)
    cands, _ = compiler.find_candidates(gm, list(DEFAULT_PATTERNS))
    found = Counter(c.pattern for c in cands)
    ctx = compiler.PassContext(program=f"audit:{name}")
    compiler.default_pass_manager().run(gm, program=f"audit:{name}",
                                        ctx=ctx)
    applied = Counter(r["pattern"] for r in ctx.applied())
    expected = floors(arch, LAYERS)
    rows, ok = [], True
    for pat in sorted(set(found) | set(expected) | set(kernels)):
        f, a, k = found.get(pat, 0), applied.get(pat, 0), kernels.get(pat, 0)
        exp = expected.get(pat, 0)
        status = "ok"
        if f - a > 0:
            status, ok = "MISSED", False
        elif a + k < exp:
            status, ok = "NOT-FOUND", False
        rows.append({"model": name, "pattern": pat, "found": f,
                     "applied": a, "missed": f - a, "kernel_nodes": k,
                     "expected": exp, "status": status})
    return rows, ctx.fallbacks(), ok


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    if as_json:
        argv.remove("--json")
    names = list(MODELS)
    if "--models" in argv:
        i = argv.index("--models")
        names = [n for n in argv[i + 1].split(",") if n]
        del argv[i:i + 2]
    all_rows, all_fallbacks, ok = [], [], True
    for name in names:
        if name not in MODELS:
            print(f"fusion_audit_torch: unknown model {name!r} "
                  f"(have {sorted(MODELS)})", file=sys.stderr)
            return 2
        rows, fallbacks, model_ok = audit_model(name)
        all_rows.extend(rows)
        all_fallbacks.extend(fallbacks)
        ok = ok and model_ok
    if as_json:
        print(json.dumps({"ok": ok, "rows": all_rows,
                          "fallbacks": all_fallbacks}, indent=2,
                         default=str))
    else:
        for r in all_rows:
            print(f"model={r['model']} pattern={r['pattern']} "
                  f"found={r['found']} applied={r['applied']} "
                  f"missed={r['missed']} kernel_nodes={r['kernel_nodes']} "
                  f"expected={r['expected']} [{r['status']}]")
        for fb in all_fallbacks:
            print(f"  fallback: program={fb.get('program')} "
                  f"pattern={fb.get('pattern')} "
                  f"reason={fb.get('reason', '?')}")
        print("fusion audit:", "pass" if ok else
              "FAIL (fusable pattern missed or coverage below the floor)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
